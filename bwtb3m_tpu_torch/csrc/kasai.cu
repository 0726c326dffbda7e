// The word-window Kasai walk that computes PLCP (sm_90a).
//
// Port of bwtb3m_tpu/lcp/plcp.py::_kasai_chunk2_impl.  The positions of a
// slab [a, a + slab) are split into lanes; lane i owns [p, pend) and
// carries l, the LCP it inherited (Kasai: PLCP[p + 1] >= PLCP[p] - 1).  A
// step of a lane reads r = ISA[p] and q = Phi[p] = SA[r - 1], then
//   extend: when r != 0 and the symbols at p + l and q + l (both mod n)
//           match, l += k, where k is the number of equal leading symbols
//           of the two uint32 text windows there: 8 nibbles (sigma <= 16)
//           or 4 bytes, counted as the trailing zero bits of their XOR;
//           k is capped by n - (p + l), n - (q + l) and n - l, so a window
//           that runs past the text's end (its pad word reads zeros, not
//           the wrapped text) never counts past it, and l never passes n;
//   commit: otherwise PLCP[p] = (r != 0 ? l : 0), l drops by one (to 0 at
//           rank 0), and the lane moves to p + 1.
// The steps are the reference's, one for one, so a step cap (the
// reference's fixed-length chunk) leaves the same (PLCP, p, l).
//
// One thread runs one lane to pend in one launch: the reference cuts the
// walk into 2,048-step chunks with a host poll after each only because a
// fori_loop has a fixed length.  A step depends on the one before it, and
// its one random access is the window at q + l (two words, most often one
// 32-byte sector); ISA, Phi and PLCP are read and written at consecutive
// positions of the lane, the window at p + l likewise.  So a lane is
// bound by the latency of that random read, and 2^17 lanes in flight hide
// it: the walk follows the card's rate of random sector reads, as the LF
// walk does (lf_walk.cu).  Measured rates: PERF.md.
//
// Positions, ISA, Phi, PLCP and l are uint32 (n < 2^32); p + l and q + l
// are summed in 64 bits before they wrap.  The window shift uses
// __funnelshift_r, which is right at an aligned index too, where the
// reference has to mask w1 << (32 - 0).
//
// The entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() right after the launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Lanes {
  const uint32_t* words;   // text, LSB-first symbols, + one pad word
  const uint32_t* phi;     // Phi[a .. a + slab)
  const uint32_t* isa;     // ISA[a .. a + slab)
  uint32_t* plcp;          // PLCP[a .. a + slab)
  uint32_t* p;             // per lane: next position, updated
  uint32_t* l;             // per lane: carried LCP, updated
  const uint32_t* pend;    // per lane: end of its positions
  int32_t* taken;          // per lane: steps taken (nullptr: not kept)
  uint32_t n, a;
  long long steps;         // cap on each lane's steps
  int nlanes;
};

template <int BITS>
__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ words,
                                           uint32_t idx) {
  constexpr int kShift = BITS == 4 ? 3 : 2;       // symbols -> words
  constexpr uint32_t kMask = (32 / BITS) - 1;
  const uint32_t wi = idx >> kShift;
  const uint32_t w0 = __ldg(words + wi);
  const uint32_t w1 = __ldg(words + wi + 1);
  return __funnelshift_r(w0, w1, (idx & kMask) * BITS);
}

__device__ __forceinline__ uint32_t wrap(uint32_t x, uint32_t l, uint32_t n) {
  const unsigned long long s = (unsigned long long)x + l;
  return (uint32_t)(s >= n ? s - n : s);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads) kasai_kernel(Lanes w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w.nlanes) return;
  constexpr int kSymShift = BITS == 4 ? 2 : 3;    // bits -> symbols
  const uint32_t n = w.n, pend = w.pend[i];
  uint32_t p = w.p[i], l = w.l[i], r = 0, q = 0;
  if (p < pend) {
    r = __ldg(w.isa + (p - w.a));
    q = __ldg(w.phi + (p - w.a));
  }
  long long s = 0;
  for (; s < w.steps && p < pend; ++s) {
    if (r != 0) {
      const uint32_t pl = wrap(p, l, n), ql = wrap(q, l, n);
      const uint32_t x = window<BITS>(w.words, pl) ^ window<BITS>(w.words, ql);
      // trailing zero bits of x; x == 0 gives 32, i.e. the whole window
      uint32_t k = (uint32_t)__popc((x & (0u - x)) - 1u) >> kSymShift;
      k = min(k, min(n - pl, min(n - ql, n - l)));
      if (k != 0) {
        l += k;
        continue;
      }
    }
    w.plcp[p - w.a] = r != 0 ? l : 0u;
    l = r != 0 && l != 0 ? l - 1 : 0u;
    if (++p < pend) {
      r = __ldg(w.isa + (p - w.a));
      q = __ldg(w.phi + (p - w.a));
    }
  }
  w.p[i] = p;
  w.l[i] = l;
  if (w.taken) w.taken[i] = (int32_t)s;
}

}  // namespace

// bits: 4 (8 nibbles per window) or 8 (4 bytes); steps < 0: no cap;
// taken (int32 per lane, may be null): the steps each lane took.
extern "C" int bwt_kasai_plcp(const void* words, const void* phi, const void* isa,
                              void* plcp, void* p, void* l, const void* pend,
                              void* taken, int nlanes, long long n, long long a,
                              int bits, long long steps, void* stream) {
  Lanes w;
  w.words = static_cast<const uint32_t*>(words);
  w.phi = static_cast<const uint32_t*>(phi);
  w.isa = static_cast<const uint32_t*>(isa);
  w.plcp = static_cast<uint32_t*>(plcp);
  w.p = static_cast<uint32_t*>(p);
  w.l = static_cast<uint32_t*>(l);
  w.pend = static_cast<const uint32_t*>(pend);
  w.taken = static_cast<int32_t*>(taken);
  w.n = (uint32_t)n;
  w.a = (uint32_t)a;
  w.steps = steps < 0 ? LLONG_MAX : steps;
  w.nlanes = nlanes;
  const int grid = (nlanes + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4) {
    kasai_kernel<4><<<grid, kThreads, 0, s>>>(w);
  } else {
    kasai_kernel<8><<<grid, kThreads, 0, s>>>(w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
