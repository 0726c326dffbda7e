// Writes the node bitvectors of a Huffman-shaped wavelet tree (the .hwt of
// index/wavelet.py) from a uint8 BWT on the card (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the tree on the host
// (bwtb3m_tpu/index/wavelet.py::_WaveletBase.build, _node_bits: per inner
// node, a gather of every symbol through two tables).  The port did the
// same on one host thread after downloading the BWT; this kernel takes the
// BWT the sort left on the card and leaves only the file's header and its
// write to the host.
//
// Per inner node j (at most kMaxNodes), tab[s] holds in bit j whether
// symbol s's code passes through node j and in bit 16 + j the bit it takes
// there.  Node j's bitvector is, in text order, the bit of every symbol
// that passes through it: LSB-first in u64 words, as RankBitVector.words
// holds it; node j starts on a word boundary and its bits past its length
// are 0 (the output is zeroed by the caller).
//
// Two passes over the text, which is cut into segments of kSeg symbols, one
// warp a segment, kWarps segments a block (a tile):
//   1. bwt_hwt_tile_counts: counts[j * nseg + g] = the symbols of segment
//      g that pass through node j.  A lane adds the membership bytes of its
//      symbols (one byte a node, four nodes a word) and the warp sums them.
//   2. The caller turns the counts into offsets[j * (nseg + 1) + g], the
//      absolute output bit of segment g's first bit of node j (an exclusive
//      sum over the segments plus the node's first word * 64), with a
//      column for the end (torch glue: a cumsum along each node's row, the
//      contiguous dimension).
//   3. bwt_hwt_node_words: a block stages its tile in shared memory and
//      sweeps it in warp rounds of 32 symbols, every node in one sweep: a
//      ballot of membership, each member's place from __popc(mask &
//      lanemask_lt), the round's bits packed by __reduce_or_sync and or-ed
//      into the node's buffer in shared memory at the warp's running
//      offset.  The buffers are then stored coalesced: the interior u32
//      words belong to the tile alone, the first and the last may be shared
//      with the neighbouring tiles and are or-ed with atomics, so the
//      result does not depend on the order in which blocks run.
//
// Bound: bytes.  The text is read once by each pass and the words written
// once: at 93,419,967 DNA symbols (4 inner nodes) ~0.12 GB, ~36 us at 3.35
// TB/s counting the text once.  The sweep's per-node work (a ballot, a
// popc, a reduce a round) is what the card spends beside it.
//
// The entry points launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() right after the launch.  bwt must be 16-byte
// aligned (the wrapper's check).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 1024;                  // symbols a warp (a segment)
constexpr int kTile = kWarps * kSeg;        // symbols a block
constexpr int kMaxNodes = 16;               // index/wavelet.py PER_NODE_MAX
constexpr int kBufWords = kTile / 32 + 2;   // a tile's bits of one node, u32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint8_t* __restrict__ bwt, long long n,
                 const uint32_t* __restrict__ tab, int k,
                 int* __restrict__ counts) {
  // spread[s][q]: byte b holds 1 where symbol s passes through node 4q + b
  __shared__ uint32_t spread[256][kMaxNodes / 4];
  for (int s = threadIdx.x; s < 256; s += kThreads) {
    const uint32_t m = tab[s] & 0xffffu;
#pragma unroll
    for (int q = 0; q < kMaxNodes / 4; ++q) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) w |= ((m >> (4 * q + b)) & 1u) << (8 * b);
      spread[s][q] = w;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g = (long long)blockIdx.x * kWarps + warp;
  const long long nseg = (long long)gridDim.x * kWarps;
  const int nq = (k + 3) >> 2;
  // a lane sees 32 symbols of the segment: no byte passes 32
  uint32_t acc[kMaxNodes / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < kSeg / 128; ++r) {
    const long long i = g * kSeg + r * 128 + lane * 4;
    uint32_t w = 0;
    int valid = 4;
    if (i + 4 <= n) {
      w = *reinterpret_cast<const uint32_t*>(bwt + i);
    } else {
      valid = (int)max(0LL, n - i);
      for (int b = 0; b < valid; ++b) w |= (uint32_t)bwt[i + b] << (8 * b);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < valid) {
        const uint32_t s = (w >> (8 * b)) & 0xffu;
#pragma unroll
        for (int q = 0; q < kMaxNodes / 4; ++q)
          if (q < nq) acc[q] += spread[s][q];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxNodes; ++j) {
    if (j < k) {
      const unsigned c =
          __reduce_add_sync(kFull, (acc[j >> 2] >> (8 * (j & 3))) & 0xffu);
      if (lane == 0) counts[j * nseg + g] = (int)c;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const uint8_t* __restrict__ bwt, long long n,
                const uint32_t* __restrict__ tab, int k,
                const long long* __restrict__ offsets,
                uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t sym[kTile];
  __shared__ uint32_t stab[256];
  __shared__ uint32_t buf[kMaxNodes][kBufWords];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const int len = (int)min((long long)kTile, n - t0);
  for (int s = tid; s < 256; s += kThreads) stab[s] = tab[s];
  for (int i = tid; i < k * kBufWords; i += kThreads) (&buf[0][0])[i] = 0;
  const int vecs = len >> 4;
  const uint4* src = reinterpret_cast<const uint4*>(bwt + t0);
  for (int v = tid; v < vecs; v += kThreads)
    reinterpret_cast<uint4*>(sym)[v] = src[v];
  for (int i = (vecs << 4) + tid; i < len; i += kThreads) sym[i] = bwt[t0 + i];
  __syncthreads();

  const long long g0 = (long long)blockIdx.x * kWarps;   // first segment
  const long long row = (long long)gridDim.x * kWarps + 1;
  const long long* first = offsets + g0;   // node j's: first[j * row]
  // the warp's next bit in each node's buffer; buffer bit 0 is the output
  // bit (first[j * row] & ~31)
  unsigned at[kMaxNodes];
#pragma unroll
  for (int j = 0; j < kMaxNodes; ++j)
    at[j] = j < k ? (unsigned)((first[j * row] & 31) + first[j * row + warp]
                               - first[j * row])
                  : 0u;
  const unsigned lt = lanemask_lt();
  for (int r = 0; r < kSeg / 32; ++r) {
    const int i = warp * kSeg + r * 32 + lane;
    const uint32_t t = i < len ? stab[sym[i]] : 0u;
#pragma unroll
    for (int j = 0; j < kMaxNodes; ++j) {
      if (j < k) {
        const unsigned inside = (t >> j) & 1u;
        const unsigned m = __ballot_sync(kFull, inside);
        const unsigned one = inside & (t >> (16 + j));
        const unsigned word = __reduce_or_sync(kFull, one << __popc(m & lt));
        const unsigned o = at[j];
        if (word) {
          if (lane == 0)
            atomicOr(&buf[j][o >> 5], word << (o & 31));
          else if (lane == 1 && (o & 31))
            atomicOr(&buf[j][(o >> 5) + 1], word >> (32 - (o & 31)));
        }
        at[j] = o + __popc(m);
      }
    }
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const long long b = first[j * row], e = first[j * row + kWarps];
    if (e == b) continue;
    const long long w0 = b >> 5;
    const int nw = (int)(((b & 31) + (e - b) + 31) >> 5);
    for (int q = tid; q < nw; q += kThreads) {
      const uint32_t v = buf[j][q];
      if (q == 0 || q == nw - 1) {
        if (v) atomicOr(out + w0 + q, v);
      } else {
        out[w0 + q] = v;
      }
    }
  }
}

long long tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// counts: int32 [k, nseg], nseg = tiles(n) * kWarps: the members of each
// node in each segment of kSeg symbols (segments past n count 0).
extern "C" int bwt_hwt_tile_counts(const void* bwt, long long n,
                                   const void* tab, int k, void* counts,
                                   void* stream) {
  if (n <= 0) return 0;
  count_kernel<<<(unsigned)tiles(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bwt), n, static_cast<const uint32_t*>(tab),
      k, static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

// offsets: int64 [k, nseg + 1] (step 2 above); out: the zeroed words of
// every node, as u32 (little-endian halves of the u64s).
extern "C" int bwt_hwt_node_words(const void* bwt, long long n,
                                  const void* tab, int k,
                                  const void* offsets, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  pack_kernel<<<(unsigned)tiles(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bwt), n, static_cast<const uint32_t*>(tab),
      k, static_cast<const long long*>(offsets),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
