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
//
// One thread owns one walk lane.  Every LF step reads the lane's rank row
// (one 128-byte row for the bit-plane layout), and the symbol, the occ
// checkpoint and the in-block count all come from that row.  The chain
// r -> LF(r) is a dependent load per step, so each lane is bound by load
// latency; the design keeps ~10^5 lanes in flight (one per preisa seed)
// and issues each row as independent 16-byte loads with no second
// dependent load inside a step, which turns the walk bandwidth-bound: at
// 100M symbols (50 MB of rows) 97,657 lanes x 1,024 steps took 4.1-5.0 ms
// on an H100 80GB HBM3 at 700 W, ~2.7 TB/s of 128-byte rows.  Ranks and
// positions are uint32 (n < 2^31 on the paths that call this kernel).
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
using bwt_rows::make_bp;

enum class Visit { kNone, kVerify, kHarvest };

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
};

template <Visit V, class Rows>
__device__ __forceinline__ void walk_lane(const Rows& rows, const Walk& w, int i) {
  uint32_t r = (uint32_t)w.r0[i];
  uint32_t p = V == Visit::kNone ? 0u : (uint32_t)w.p0[i];
  const int len = w.seg_len[i];
  int32_t bad = 0;
  for (int k = 0; k < len; ++k) {
    if (V == Visit::kHarvest) {
      // every rank and every position is visited by exactly one (lane,
      // step), so the sample writes are direct and race-free
      if (r % w.sarate == 0) w.sa[r / w.sarate] = (int32_t)p;
      if (p % w.isarate == 0) w.isa[p / w.isarate] = (int32_t)r;
    }
    uint32_t sym;
    r = rows.step(r, &sym);  // sym = BWT[r] = text[p - 1]
    if (V != Visit::kNone) p = p == 0 ? w.n - 1 : p - 1;
    if (V == Visit::kVerify) bad += sym != (uint32_t)__ldg(w.text + p);
  }
  w.r_out[i] = (int32_t)r;
  if (V == Visit::kVerify) w.bad[i] = bad;
}

template <Visit V>
__global__ void lf_walk_bp_kernel(const uint8_t* rows, const uint32_t* C, int sigma,
                                  Walk w, int nlanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nlanes) return;
  walk_lane<V>(make_bp(rows, C, sigma), w, i);
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
  if (roww == kBpRowBytes) {
    lf_walk_bp_kernel<V><<<grid, kThreads, 0, s>>>(rp, cp, sigma, w, nlanes);
  } else {
    lf_walk_byte_kernel<V><<<grid, kThreads, 0, s>>>(ByteRows{rp, cp, roww}, w, nlanes);
  }
}

}  // namespace

// A row width of 128 bytes selects the bit-plane layout (byte rows are at
// least 384 bytes wide).  A non-null text selects the verify visit, a
// non-null sa_out the harvest visit; p0 is read only by a visit.  Return
// value: cudaGetLastError() after the launch.
extern "C" int bwt_lf_walk(const void* rows, int roww, const void* C, int sigma,
                           long long n, const void* r0, const void* p0,
                           const void* seg_len, void* r_out, const void* text,
                           void* bad, int sarate, int isarate, void* sa_out,
                           void* isa_out, int nlanes, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (text) {
    launch<Visit::kVerify>(rows, roww, C, sigma, w, nlanes, s);
  } else if (sa_out) {
    launch<Visit::kHarvest>(rows, roww, C, sigma, w, nlanes, s);
  } else {
    launch<Visit::kNone>(rows, roww, C, sigma, w, nlanes, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
