// Expands the runs of a narrow RLB1 .bwt (io/rl.py) into dense symbols on
// the card (sm_90a), the densify done in the same pass.
//
// Replaces no TPU kernel: the JAX package decodes the .bwt on the host
// (bwtb3m_tpu/engine/result.py:212) and finds its alphabet with
// np.unique.  The port did the same, one host thread over n symbols, a
// memset a run, then a sort of n bytes for the alphabet, and copied the n
// symbols to the card for the rank rows; the kernel takes the file's runs
// instead, and the alphabet comes from the file's count table (the
// dense-id table below).
//
// A block of the file, as io/rl.py writes it (runs never cross blocks):
//   nruns u32 | nbig u32 | syms u8[nruns] | len8 u8[nruns] | big u64[nbig]
// len8 == 255 escapes to the next entry of big, in run order.  The
// decoded block b holds the symbols [b * block_size, min(n, (b + 1) *
// block_size)).
//
// One CTA decodes one block, with no scan across blocks.  It takes the
// runs in tiles of kTile: a block-wide scan of the escape flags gives
// each escape its index in big, a block-wide scan of the lengths gives
// each run its start.  The block's output is staged in shared memory in
// windows of kStage bytes: a thread fills chunks of 16 positions, finding
// the run of a chunk's first position by a binary search of the tile's
// starts and walking on, and writes each symbol through the 256-entry
// dense-id table.  A full window is stored coalesced, 16 bytes a thread
// where the destination is 16-byte aligned.
//
// The CTA checks the block against its byte range [ends[j], ends[j+1]):
// the range lies in the slab's bytes, the header and the arrays fit in
// it, the escapes match nbig, the lengths sum to the block's length (no
// run is longer than it), and every symbol is in the table.  A fault sets a bit of *err (kErr*) and leaves
// the output unspecified; nothing is read outside the range, nothing
// written outside the block.
//
// Bound: the kernel reads the payload once and writes n bytes.  At
// 400,000,001 symbols (a ~0.5 GB payload) that is ~0.3 ms at 3.35 TB/s,
// far below the host's read of the file, which bounds the load; so the
// design is simple rather than fast: one thread a 16-byte chunk, a
// binary search a chunk.
//
// The entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunsPerThread = 8;
constexpr int kTile = kThreads * kRunsPerThread;   // runs a tile
constexpr int kStage = 32768;                      // output bytes a window
constexpr int kChunk = 16;                         // positions a thread fills

constexpr int kErrHeader = 1;   // header or arrays outside the byte range
constexpr int kErrEscape = 2;   // escapes do not match nbig
constexpr int kErrLength = 4;   // lengths do not sum to the block's length
constexpr int kErrSymbol = 8;   // a symbol outside the alphabet

struct Slab {
  const uint8_t* payload;   // the file's bytes [base, base + nbytes)
  const long long* ends;    // [nblk + 1]: absolute offset of each block, then
                            // the end of the last
  long long base, nbytes;
  long long b0;             // the file's index of the slab's first block
  long long block_size, n;
  const int16_t* table;     // dense id of each byte symbol, -1: absent
  uint8_t* out;             // the n dense symbols
  int* err;
};

__device__ __forceinline__ unsigned long long ld_le(const uint8_t* p, int k) {
  unsigned long long v = 0;
  for (int i = 0; i < k; ++i) v |= (unsigned long long)p[i] << (8 * i);
  return v;
}

// Exclusive block-wide sum of v; *total gets the sum of all threads.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* warp_sums, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const T before = (warp ? warp_sums[warp - 1] : T(0)) + x - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();   // warp_sums is reused by the next scan
  return before;
}

// Stores stage[0, len) to dst[0, len).
__device__ __forceinline__ void flush(const uint8_t* stage, uint8_t* dst,
                                      int len) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    const int vecs = len / 16;
    const uint4* s = reinterpret_cast<const uint4*>(stage);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < vecs; i += kThreads) d[i] = s[i];
    head = vecs * 16;
  }
  for (int i = head + threadIdx.x; i < len; i += kThreads) dst[i] = stage[i];
}

__global__ void __launch_bounds__(kThreads) rl_decode_kernel(Slab s) {
  __shared__ int16_t table[256];
  __shared__ uint8_t sym[kTile];
  __shared__ uint8_t len8[kTile];
  __shared__ uint32_t start[kTile + 1];   // block-relative, clamped to blen
  __shared__ __align__(16) uint8_t stage[kStage];
  __shared__ unsigned long long wsum64[kWarps];
  __shared__ int wsum32[kWarps];

  const int tid = threadIdx.x;
  const long long j = blockIdx.x;
  const long long o0 = (s.b0 + j) * s.block_size;
  const long long blen = min(s.block_size, s.n - o0);
  const long long at = s.ends[j] - s.base;
  const long long avail = s.ends[j + 1] - s.ends[j];
  const uint8_t* blk = s.payload + at;
  uint8_t* dst = s.out + o0;
  for (int i = tid; i < 256; i += kThreads) table[i] = s.table[i];
  if (at < 0 || avail < 8 || at + avail > s.nbytes) {
    if (tid == 0) atomicOr(s.err, kErrHeader);
    return;
  }
  const unsigned long long nruns = ld_le(blk, 4), nbig = ld_le(blk + 4, 4);
  if (8 + 2 * nruns + 8 * nbig > (unsigned long long)avail) {
    if (tid == 0) atomicOr(s.err, kErrHeader);
    return;
  }
  const uint8_t* syms = blk + 8;
  const uint8_t* lens = syms + nruns;
  const uint8_t* big = lens + nruns;
  int bad = 0;
  // pos: start of the tile's first run, saturated at blen + 1
  unsigned long long pos = 0, esc = 0;
  long long wb = 0;   // first position of the open window
  for (unsigned long long t0 = 0; t0 < nruns; t0 += kTile) {
    const int m = (int)min((unsigned long long)kTile, nruns - t0);
    for (int i = tid; i < m; i += kThreads) {
      sym[i] = syms[t0 + i];
      len8[i] = lens[t0 + i];
    }
    __syncthreads();
    const int r0 = tid * kRunsPerThread;
    int e = 0;
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k)
      e += (r0 + k < m && len8[r0 + k] == 255) ? 1 : 0;
    int etot;
    unsigned long long ei = esc + block_scan(e, wsum32, &etot);
    unsigned long long l[kRunsPerThread], sum = 0;
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      unsigned long long v = 0;
      if (r0 + k < m) {
        v = len8[r0 + k];
        if (v == 255) {
          if (ei < nbig) {
            v = ld_le(big + 8 * ei, 8);
          } else {
            v = 0;
            bad |= kErrEscape;
          }
          ++ei;
        }
        if (v > (unsigned long long)blen) {   // keeps the sums from wrapping
          v = blen + 1;
          bad |= kErrLength;
        }
        if (table[sym[r0 + k]] < 0) bad |= kErrSymbol;
      }
      l[k] = v;
      sum += v;
    }
    unsigned long long tot;
    unsigned long long st = pos + block_scan(sum, wsum64, &tot);
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      if (r0 + k < m) start[r0 + k] = (uint32_t)min(st, (unsigned long long)blen);
      st += l[k];
    }
    if (tid == 0) start[m] = (uint32_t)min(pos + tot, (unsigned long long)blen);
    __syncthreads();
    const long long lo = start[0], hi = start[m];
    long long q0 = max(lo, wb);
    while (true) {
      const long long we = min(wb + kStage, blen);
      const long long e1 = min(hi, we);
      // chunks of 16 positions from wb; those that meet [q0, e1)
      const long long c0 = (q0 - wb) / kChunk;
      const long long c1 = (e1 - wb + kChunk - 1) / kChunk;
      for (long long c = c0 + tid; c < c1; c += kThreads) {
        const long long a = max(q0, wb + c * kChunk);
        const long long z = min(e1, wb + (c + 1) * kChunk);
        int lo_r = 0, hi_r = m - 1;   // the last run with start <= a
        while (lo_r < hi_r) {
          const int mid = (lo_r + hi_r + 1) >> 1;
          if ((long long)start[mid] <= a) lo_r = mid; else hi_r = mid - 1;
        }
        int r = lo_r;
        for (long long q = a; q < z; ++q) {
          while ((long long)start[r + 1] <= q) ++r;
          stage[q - wb] = (uint8_t)table[sym[r]];
        }
      }
      if (hi < we || we == blen) break;
      __syncthreads();   // the window is full
      flush(stage, dst + wb, (int)(we - wb));
      __syncthreads();
      wb = we;
      q0 = wb;
    }
    pos = min(pos + tot, (unsigned long long)blen + 1);
    esc += etot;
    __syncthreads();   // the next tile overwrites sym, len8, start
  }
  if (wb < blen) {
    __syncthreads();
    flush(stage, dst + wb, (int)(min(wb + kStage, blen) - wb));
  }
  if (pos != (unsigned long long)blen) bad |= kErrLength;
  if (esc != nbig) bad |= kErrEscape;
  if (bad) atomicOr(s.err, bad);
}

}  // namespace

// One launch decodes the nblk blocks of a slab: payload holds nbytes of
// the file's bytes from offset base, ends[0 .. nblk] the blocks' absolute
// offsets and the end of the last; block j is the file's block b0 + j.  table: 256
// int16 dense ids (-1: not in the alphabet); out: n bytes; err: one int32,
// or-ed with the kErr bits of every faulty block.
extern "C" int bwt_rl_decode_u8(const void* payload, long long nbytes,
                                const void* ends, long long base,
                                long long nblk, long long b0,
                                long long block_size, long long n,
                                const void* table, void* out, void* err,
                                void* stream) {
  Slab s;
  s.payload = static_cast<const uint8_t*>(payload);
  s.ends = static_cast<const long long*>(ends);
  s.base = base;
  s.nbytes = nbytes;
  s.b0 = b0;
  s.block_size = block_size;
  s.n = n;
  s.table = static_cast<const int16_t*>(table);
  s.out = static_cast<uint8_t*>(out);
  s.err = static_cast<int*>(err);
  if (nblk <= 0) return 0;
  rl_decode_kernel<<<(unsigned)nblk, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}

extern "C" const char* bwt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
