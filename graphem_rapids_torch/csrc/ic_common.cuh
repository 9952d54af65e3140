// Pieces shared by the two Independent-Cascade kernels: the gather form
// (ic_cascade.cu) and the scatter form (ic_scatter.cu). Both run a whole
// cascade in one cooperative launch on state packed 32 columns to a word
// (column b of vertex v is bit b % 32 of word v * W + b / 32).
//
// - Ctl: the wrapper's zeroed control words (ops/ic_cascade.py CTL_WORDS):
//   activations so far by step parity, the grid barrier's arrivals and the
//   step count.
// - fired: the coins of one word. coin(t, v, j, b) = philox4x32_10(counter
//   = (r >> 2, j, v, t), key)[r & 3] < thr with r = b mod runs: columns
//   b and b + runs draw the same coins (runs = B: every column its own).
//   One draw serves the bits of a word whose runs share a nibble.
// - grid_barrier: every block of the cooperative grid meets; writes before
//   it are visible to every block after it.
// - step_continues: the stop test, with nothing to reset between steps.
// - count_columns: the (B,) active counts, deterministic integer sums.
//
// State written inside a launch is read with ld.global.cg (__ldcg), so no
// stale L1 line is seen across a barrier.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ic {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns counted per pass of count_columns (shared memory, 16 KB).
constexpr int kCountCols = 4096;

struct Ctl {
  unsigned long long newly[2];  // activations so far, by step parity
  unsigned long long barrier;   // grid-barrier arrivals, monotonic
  unsigned int steps;           // steps run, written at the end
  unsigned int pad;
};
static_assert(sizeof(Ctl) == 32, "Ctl is CTL_WORDS int32 words");

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

// The four coins of nibble g of run numbers (runs r = 4 g .. 4 g + 3) at
// step t, slot j, receiver v: lane l in bit l.
__device__ __forceinline__ uint32_t nibble_coins(uint32_t g, uint32_t t,
                                                 uint32_t v, uint32_t j,
                                                 uint32_t k0, uint32_t k1,
                                                 unsigned long long thr) {
  uint32_t c[4] = {g, j, v, t};
  philox4x32_10(c, k0, k1);
  return (c[0] < thr ? 1u : 0u) | (c[1] < thr ? 2u : 0u) |
         (c[2] < thr ? 4u : 0u) | (c[3] < thr ? 8u : 0u);
}

// The bits of `cand` (columns b = 32 w + i of receiver v) whose coin at
// step t, slot j fires, column b drawing as run r = b mod runs. Where runs
// is a multiple of 4 (or at least B, so that r = b), the four columns of a
// nibble of the word are four consecutive runs: one draw serves them.
// Otherwise each candidate bit finds its run, and a draw serves the bits
// that follow it while their runs share its nibble.
__device__ __forceinline__ uint32_t fired(uint32_t cand, uint32_t t,
                                          uint32_t v, uint32_t j, uint32_t w,
                                          uint32_t runs, uint32_t k0,
                                          uint32_t k1,
                                          unsigned long long thr) {
  uint32_t out = 0;
  if ((runs & 3u) == 0u || runs >= w * 32u + 32u) {
    while (cand) {
      const uint32_t g = static_cast<uint32_t>(__ffs(cand) - 1) >> 2;
      uint32_t r = w * 32u + 4u * g;
      if (r >= runs) r %= runs;
      out |= (nibble_coins(r >> 2, t, v, j, k0, k1, thr) << (4u * g)) & cand;
      cand &= ~(0xFu << (4u * g));
    }
    return out;
  }
  uint32_t last = 0xFFFFFFFFu;  // the nibble of the last draw
  uint32_t f = 0;               // its four coins
  while (cand) {
    const int i = __ffs(cand) - 1;
    uint32_t r = w * 32u + static_cast<uint32_t>(i);
    if (r >= runs) r %= runs;
    if ((r >> 2) != last) {
      last = r >> 2;
      f = nibble_coins(last, t, v, j, k0, k1, thr);
    }
    out |= ((f >> (r & 3u)) & 1u) << i;
    cand &= cand - 1u;
  }
  return out;
}

// All blocks of the (cooperative) grid meet here; `epoch` counts this
// block's barriers. Writes before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long& epoch) {
  __syncthreads();
  ++epoch;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
    const unsigned long long target = epoch * gridDim.x;
    while (*reinterpret_cast<volatile unsigned long long*>(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The end of step t: the block adds the popcounts of its threads' newly
// words (`mine`) to the total of t's parity, meets the grid, and returns
// whether that total grew (some block activated someone), the same answer
// in every block. Nothing is reset: a parity's total is next added to two
// steps later, after a barrier that every block passes only once it has
// read it. `seen` is thread 0's last total of each parity.
__device__ __forceinline__ bool step_continues(Ctl* ctl, int t,
                                               unsigned long long mine,
                                               unsigned long long& epoch,
                                               unsigned long long seen[2]) {
  __shared__ unsigned long long s_sum[kWarps];
  __shared__ int s_go;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(~0u, mine, d);
  if (lane == 0) s_sum[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
    for (int k = 0; k < kWarps; ++k) block += s_sum[k];
    if (block) atomicAdd(&ctl->newly[t & 1], block);
  }
  grid_barrier(&ctl->barrier, epoch);
  if (threadIdx.x == 0) {
    const unsigned long long total = __ldcg(&ctl->newly[t & 1]);
    s_go = total != seen[t & 1];
    seen[t & 1] = total;
  }
  __syncthreads();
  return s_go != 0;
}

// counts[c] += the active bits of column c over all n vertices, for the B
// columns. Per pass kCountCols columns; a warp takes 32 vertices of one
// word, one ballot per bit, and lane i adds column 32 w + i's count to
// shared memory; each block then adds one integer per column.
__device__ __forceinline__ void count_columns(const uint32_t* active,
                                              int* counts, int n, int W,
                                              int B) {
  __shared__ int s_cnt[kCountCols];
  const int lane = threadIdx.x & 31;
  const long long gwarp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const long long vchunks = (n + 31) / 32;
  for (int c0 = 0; c0 < B; c0 += kCountCols) {
    const int ncol = min(kCountCols, B - c0);
    const int w0 = c0 / 32;
    const int nw = (ncol + 31) / 32;
    for (int c = threadIdx.x; c < ncol; c += kThreads) s_cnt[c] = 0;
    __syncthreads();
    for (long long u = gwarp; u < vchunks * nw; u += nwarps) {
      const int wl = static_cast<int>(u % nw);
      const long long v = (u / nw) * 32 + lane;
      const uint32_t x =
          v < n ? __ldcg(active + v * W + w0 + wl) : 0u;
      int my = 0;
#pragma unroll
      for (int bit = 0; bit < 32; ++bit) {
        const int c = __popc(__ballot_sync(~0u, (x >> bit) & 1u));
        if (lane == bit) my = c;
      }
      const int col = wl * 32 + lane;
      if (my && col < ncol) atomicAdd(&s_cnt[col], my);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < ncol; c += kThreads) {
      if (s_cnt[c]) atomicAdd(counts + c0 + c, s_cnt[c]);
    }
    __syncthreads();
  }
}

}  // namespace ic
