// The merge engine's gap-chain kernel (sm_90a).
//
// Port of bwtb3m_tpu/ops/gapdev.py::_chain_chunk_impl (the recording form)
// and ::_anchor_chunk_impl (the anchor form), the device programs of one
// pair merge of a left block [s, m) into a right region M = [m, e).  Lane
// j walks text positions p = starts[j], starts[j]-1, ... for lens[j] steps
// from the seed r = R(starts[j] + 1).  Each step:
//
//   c  = text[p]                      flat uint8 device text
//   g  = bit (p - lo0) of gt          wrap-term bit: rot(p+1) > rot(e)
//   r' = c_first[c] + rank(c, r) - [k0 < r && c == k1] + [c == k2 && g]
//
// with (k0, k1, k2) = (isa_m, text[m-1], text[e-1]) and rank over the
// right region's fused rank rows (focc_rows.cuh, shared with lf_walk.cu).
// The recording form adds one to gap[r'] (an int32 histogram with one cell
// per right rank, gap_size + 1 cells), writes r' into samp[(p - samp_p0) /
// rate] where p is a multiple of rate (every position is walked by one
// (lane, step), so the write is race-free; the value is R(p), the rank
// after the step at p), and ends with the lane's final rank.  The anchor
// form takes the same steps and keeps only the final rank.
//
// What bounds it: one thread per lane, and every step makes one dependent
// rank-row load (128 bytes on bit-plane rows), as in the LF walk, plus one
// histogram atomic, which is fire-and-forget (its result is unused, so it
// compiles to a reduction that does not stall the lane).  The text and gt
// bytes do not depend on the rank chain and overlap with it.  ~65,536
// lanes keep enough loads in flight to cover the latency.  The reference
// read text and gt from phase-aligned 256-symbol rows with every lane
// padded to one shared column per step; here each lane reads its own byte
// and takes exactly its own steps, so no padding or masking is needed.
//
// Ranks and positions are uint32 (the caller asserts n < 2^32 and refuses
// wide merges).  The entry point launches on the caller's stream, does not
// synchronise and returns cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "focc_rows.cuh"

namespace {

constexpr int kThreads = 256;

struct Chain {
  const uint8_t* text;      // dense text, n symbols
  const uint8_t* gt;        // wrap-term bits over [lo0, cap), LSB first
  uint32_t lo0;
  const uint32_t* c_first;  // c_first[c]: right rotations starting below c
  uint32_t k0, k1, k2;      // isa_m, sym_before_m, sym_last
  const int64_t* starts;    // first walk position of each lane
  const int32_t* seeds;     // R(starts + 1)
  const int32_t* lens;      // steps of each lane
  int32_t* r_out;           // final rank of each lane
  int32_t* gap;             // recording form: histogram of every R
  int32_t* samp;            // recording form: R at the sampled positions
  uint32_t samp_p0;         // first sampled position (a multiple of rate)
  uint32_t rate;
};

template <bool kRecord, class Rows>
__device__ __forceinline__ void chain_lane(const Rows& rows, const Chain& ch, int j) {
  uint32_t r = (uint32_t)ch.seeds[j];
  uint32_t p = (uint32_t)ch.starts[j];
  const int len = ch.lens[j];
  uint32_t phase = kRecord ? p % ch.rate : 0u;  // p mod rate, counted down
  for (int k = 0; k < len; ++k) {
    const uint32_t c = __ldg(ch.text + p);
    const uint32_t off = p - ch.lo0;
    const uint32_t g = (__ldg(ch.gt + (off >> 3)) >> (off & 7u)) & 1u;
    const uint32_t rk = rows.rank(c, r);
    r = __ldg(ch.c_first + c) + rk - (uint32_t)(ch.k0 < r && c == ch.k1) +
        (uint32_t)(c == ch.k2 && g);
    if (kRecord) {
      atomicAdd(ch.gap + r, 1);
      if (phase == 0) {
        ch.samp[(p - ch.samp_p0) / ch.rate] = (int32_t)r;
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
__global__ void chain_byte_kernel(bwt_rows::ByteRows rows, Chain ch, int nlanes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nlanes) return;
  chain_lane<kRecord>(rows, ch, j);
}

template <bool kRecord>
void launch(const uint8_t* rows, int roww, const Chain& ch, int nlanes, cudaStream_t s) {
  const int grid = (nlanes + kThreads - 1) / kThreads;
  if (roww == bwt_rows::kBpRowBytes) {
    chain_bp_kernel<kRecord><<<grid, kThreads, 0, s>>>(rows, ch, nlanes);
  } else {
    chain_byte_kernel<kRecord>
        <<<grid, kThreads, 0, s>>>(bwt_rows::ByteRows{rows, nullptr, roww}, ch, nlanes);
  }
}

}  // namespace

// A row width of 128 bytes selects the bit-plane layout.  A non-null gap
// selects the recording form (then samp must be non-null too); a null gap
// the anchor form.  Return value: cudaGetLastError() after the launch.
extern "C" int bwt_gap_chain(const void* rows, int roww, const void* text, const void* gt,
                             long long lo0, const void* c_first, unsigned k0, unsigned k1,
                             unsigned k2, const void* starts, const void* seeds,
                             const void* lens, void* r_out, void* gap, void* samp,
                             long long samp_p0, int rate, int nlanes, void* stream) {
  Chain ch;
  ch.text = static_cast<const uint8_t*>(text);
  ch.gt = static_cast<const uint8_t*>(gt);
  ch.lo0 = (uint32_t)lo0;
  ch.c_first = static_cast<const uint32_t*>(c_first);
  ch.k0 = k0;
  ch.k1 = k1;
  ch.k2 = k2;
  ch.starts = static_cast<const int64_t*>(starts);
  ch.seeds = static_cast<const int32_t*>(seeds);
  ch.lens = static_cast<const int32_t*>(lens);
  ch.r_out = static_cast<int32_t*>(r_out);
  ch.gap = static_cast<int32_t*>(gap);
  ch.samp = static_cast<int32_t*>(samp);
  ch.samp_p0 = (uint32_t)samp_p0;
  ch.rate = (uint32_t)rate;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const uint8_t*>(rows);
  if (gap) {
    launch<true>(rp, roww, ch, nlanes, s);
  } else {
    launch<false>(rp, roww, ch, nlanes, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
