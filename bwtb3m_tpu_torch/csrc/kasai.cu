// The word-window Kasai walk that computes PLCP (sm_90a).
//
// Port of bwtb3m_tpu/lcp/plcp.py::_kasai_chunk2_impl.  The positions of a
// slab [a, a + slab) are split into lanes; lane i owns [p, pend) and
// carries l, the LCP it inherited (Kasai: PLCP[p + 1] >= PLCP[p] - 1).  A
// step of a lane takes q = Phi[p] = SA[ISA[p] - 1] and
//   extend: when p is not p0 = SA[0] (the one position of rank 0, which
//           has no predecessor) and the symbols at p + l and q + l (both
//           mod n) match, l += k, where k is the number of equal leading
//           symbols of the two uint32 text windows there: 8 nibbles
//           (sigma <= 16) or 4 bytes, counted as the trailing zero bits of
//           their XOR; k is capped by n - (p + l), n - (q + l) and n - l,
//           so a window that runs past the text's end (its pad word reads
//           zeros, not the wrapped text) never counts past it, and l never
//           passes n;
//   commit: otherwise PLCP[p] = (p != p0 ? l : 0), l drops by one (to 0
//           at p0), and the lane moves to p + 1.
// The steps are the reference's, one for one, so a step cap (the
// reference's fixed-length chunk) leaves the same (PLCP, p, l).  The
// reference reads ISA[p] at every step only to test rank != 0, which
// fails at p0 alone: the walk takes p0 and reads no ISA.
//
// One thread runs one lane to pend in one launch: the reference cuts the
// walk into 2,048-step chunks with a host poll after each only because a
// fori_loop has a fixed length.  A step depends on the one before it, so
// a lane is bound by the latency of its random reads, and the walk by how
// many lanes keep reads in flight.  Its one random read is the window at
// q + l.  Everything else a lane touches runs along its positions: Phi
// and PLCP at p, the window at p + l, which does not decrease along a
// lane except at p0 and at the wrap past n.  Read a word at a time, those
// streams kept about three 128-byte lines of each lane live in the L2
// between its visits, and 2^17 lanes (the reference's count) filled the
// 50 MB L2 and ran 3.2x slower than 2^15, too few to hide the latency.
// So a lane keeps its streams in registers:
//   Phi: the aligned 32-byte sector, loaded whole (two 16-byte loads)
//        when the lane enters it; single words from a lane's ragged start
//        to its first sector, and where a sector would reach past the
//        slab;
//   PLCP: the values of the current aligned sector, stored whole when
//        the lane leaves it having written all eight, else word by word
//        (the lane's ragged ends, whose sector it shares with a
//        neighbour, and the end of a launch cut by a step cap);
//   windows: the two words under the p + l window and, likewise, under
//        the q + l window; a window that moves to the next word loads one
//        word, one that stays loads none, one that jumps (q after a
//        commit) loads two.
// A step then makes one random read at most, most often one per position.
// Measured by chip_smoke.py and chip_ab.py on an NVIDIA H100 80GB HBM3 at
// 700 W, n = 1,200,000,011 DNA symbols, 1.8 G steps: 48.9 ms at 2^17
// lanes (36.8 G steps/s, about the card's rate of random sector reads),
// where the word-at-a-time walk took 81.2 ms at its best, 2^15 lanes, and
// 260 at 2^17; 1.6-1.75x likewise on a text of long repeats and on the
// slab route.  The three register structures pay for themselves only
// with many lanes: at 2^17 lanes the walk takes 1.6x as long with both
// windows read whole at every step, and 2.7x or 2.9x with that and Phi or
// PLCP a word at a time.  With few lanes, where a lane waits on its own
// instructions and no line is evicted, they cost: at 128 lanes this walk
// takes 1.4x as long as the word-at-a-time walk without ISA.
// lcp/plcp.py runs 2^17 lanes (LANES), on texts past 2^22 symbols.
//
// Positions, Phi, PLCP and l are uint32 (n < 2^32); p + l and q + l are
// summed in 64 bits before they wrap.  The window shift uses
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
  uint32_t* plcp;          // PLCP[a .. a + slab)
  uint32_t* p;             // per lane: next position, updated
  uint32_t* l;             // per lane: carried LCP, updated
  const uint32_t* pend;    // per lane: end of its positions
  int32_t* taken;          // per lane: steps taken (nullptr: not kept)
  uint32_t n, a, slab;
  uint32_t p0;             // SA[0]: the position without a predecessor
  uint32_t phi_off;        // phi's word offset within its 32-byte sector
  uint32_t plcp_off;       // plcp's likewise
  long long steps;         // cap on each lane's steps
  int nlanes;
};

// The uint32 window of symbols idx .. idx + spw - 1, over the two words
// it keeps in registers.
template <int BITS>
struct Window {
  static constexpr int kShift = BITS == 4 ? 3 : 2;       // symbols -> words
  static constexpr uint32_t kMask = (32 / BITS) - 1;
  uint32_t wi = 0xFFFFFFF0u;   // word index of w0; no j equals it or wi + 1
  uint32_t w0 = 0, w1 = 0;

  // selects in place of branches: faster at every lane count measured
  // (PERF.md)
  __device__ __forceinline__ uint32_t at(const uint32_t* __restrict__ words,
                                         uint32_t idx) {
    const uint32_t j = idx >> kShift;
    const uint32_t d = j - wi;
    const uint32_t n0 = d == 0u ? w0 : d == 1u ? w1 : __ldg(words + j);
    const uint32_t n1 = d == 0u ? w1 : __ldg(words + j + 1);
    w0 = n0;
    w1 = n1;
    wi = j;
    return __funnelshift_r(w0, w1, (idx & kMask) * BITS);
  }
};

__device__ __forceinline__ uint32_t wrap(uint32_t x, uint32_t l, uint32_t n) {
  const unsigned long long s = (unsigned long long)x + l;
  return (uint32_t)(s >= n ? s - n : s);
}

// v[0..7] <- v[1..7], v[7] <- x (constant indices: registers, no stack)
__device__ __forceinline__ void shift_in(uint32_t (&v)[8], uint32_t x) {
#pragma unroll
  for (int t = 0; t < 7; ++t) v[t] = v[t + 1];
  v[7] = x;
}

// ph[0..7] <- the aligned sector that starts at i, where i starts one and
// it lies in the slab; else ph[0] <- Phi[i] alone.  Returns how many of
// ph hold Phi values.
__device__ __forceinline__ int load_phi(const Lanes& w, uint32_t i, uint32_t (&ph)[8]) {
  if (((i + w.phi_off) & 7u) == 0u && i + 8u <= w.slab) {
    const uint4* s = reinterpret_cast<const uint4*>(w.phi + i);
    const uint4 lo = __ldg(s), hi = __ldg(s + 1);
    ph[0] = lo.x; ph[1] = lo.y; ph[2] = lo.z; ph[3] = lo.w;
    ph[4] = hi.x; ph[5] = hi.y; ph[6] = hi.z; ph[7] = hi.w;
    return 8;
  }
  ph[0] = __ldg(w.phi + i);
  return 1;
}

// Stores the cnt values buffered in pc[8 - cnt .. 7], for positions
// last - cnt + 1 .. last: one aligned 32-byte sector when all eight are
// there, else word by word.
__device__ __forceinline__ void flush(const Lanes& w, const uint32_t (&pc)[8], int cnt,
                                      uint32_t last) {
  uint32_t* dst = w.plcp + ((long long)last - 7);   // last < 7: t < 8 - cnt
  if (cnt == 8) {
    uint4* s = reinterpret_cast<uint4*>(dst);
    s[0] = make_uint4(pc[0], pc[1], pc[2], pc[3]);
    s[1] = make_uint4(pc[4], pc[5], pc[6], pc[7]);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t >= 8 - cnt) dst[t] = pc[t];
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads) kasai_kernel(Lanes w) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= w.nlanes) return;
  constexpr int kSymShift = BITS == 4 ? 2 : 3;    // bits -> symbols
  const uint32_t n = w.n, a = w.a, p0 = w.p0, pend = w.pend[lane];
  uint32_t p = w.p[lane], l = w.l[lane];
  uint32_t ph[8], pc[8];
  int left = 0, cnt = 0;
  if (p < pend) left = load_phi(w, p - a, ph);
  Window<BITS> wp, wq;
  long long s = 0;
  for (; s < w.steps && p < pend; ++s) {
    const bool prev = p != p0;
    if (prev) {
      const uint32_t pl = wrap(p, l, n), ql = wrap(ph[0], l, n);
      const uint32_t x = wp.at(w.words, pl) ^ wq.at(w.words, ql);
      // trailing zero bits of x; x == 0 gives 32, i.e. the whole window
      uint32_t k = (uint32_t)__popc((x & (0u - x)) - 1u) >> kSymShift;
      k = min(k, min(n - pl, min(n - ql, n - l)));
      if (k != 0) {
        l += k;
        continue;
      }
    }
    const uint32_t i = p - a;
    shift_in(pc, prev ? l : 0u);
    ++cnt;
    if (((i + 1u + w.plcp_off) & 7u) == 0u) {   // i ends its sector
      flush(w, pc, cnt, i);
      cnt = 0;
    }
    l = prev && l != 0 ? l - 1 : 0u;
    ++p;
    shift_in(ph, 0u);
    if (--left == 0 && p < pend) left = load_phi(w, i + 1u, ph);
  }
  if (cnt) flush(w, pc, cnt, p - a - 1u);
  w.p[lane] = p;
  w.l[lane] = l;
  if (w.taken) w.taken[lane] = (int32_t)s;
}

}  // namespace

// p0 = SA[0]; bits: 4 (8 nibbles per window) or 8 (4 bytes); slab: the
// positions phi holds (plcp holds at least as many); steps < 0: no cap;
// taken (int32 per lane, may be null): the steps each lane took.  phi and
// plcp need 4-byte alignment only: their sectors are found from their
// addresses.
extern "C" int bwt_kasai_plcp(const void* words, const void* phi, long long p0,
                              void* plcp, void* p, void* l, const void* pend,
                              void* taken, int nlanes, long long n, long long a,
                              long long slab, int bits, long long steps,
                              void* stream) {
  Lanes w;
  w.words = static_cast<const uint32_t*>(words);
  w.phi = static_cast<const uint32_t*>(phi);
  w.plcp = static_cast<uint32_t*>(plcp);
  w.p = static_cast<uint32_t*>(p);
  w.l = static_cast<uint32_t*>(l);
  w.pend = static_cast<const uint32_t*>(pend);
  w.taken = static_cast<int32_t*>(taken);
  w.n = (uint32_t)n;
  w.a = (uint32_t)a;
  w.slab = (uint32_t)slab;
  w.p0 = (uint32_t)p0;
  w.phi_off = (uint32_t)(reinterpret_cast<uintptr_t>(phi) >> 2) & 7u;
  w.plcp_off = (uint32_t)(reinterpret_cast<uintptr_t>(plcp) >> 2) & 7u;
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
