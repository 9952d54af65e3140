// The frontier-driven cascade shared by the two Independent-Cascade
// kernels: the gather form (ic_cascade.cu) and the scatter form
// (ic_scatter.cu). Both run a whole cascade in one cooperative launch on
// state packed 32 columns to a word (column b of vertex v is bit b % 32 of
// word v * W + b / 32); each form brings only its dense pass (`Dense`).
//
// - Ctl: the wrapper's zeroed control words (ops/ic_cascade.py CTL_WORDS):
//   the grid barrier's arrivals, the three vertex lists' counters, and
//   the steps and dense steps run.
// - fired: the coins of one word. coin(t, v, j, b) = philox4x32_10(counter
//   = (r >> 2, j, v, t), key)[r & 3] < thr with r = b mod runs: columns
//   b and b + runs draw the same coins (runs = B: every column its own).
//   One draw serves the bits of a word whose runs share a nibble.
// - grid_barrier: every block of the cooperative grid meets; writes before
//   it are visible to every block after it.
// - count_columns: the (B,) active counts, deterministic integer sums.
// - run: the cascade itself, below.
//
// The step. The push lists (ops/ic_cascade.py push_lists: the gather
// plan's table_push_lists, the scatter form's edge_push_lists) are a CSR by
// source u of the (receiver v, slot j) pairs whose coin reads u's
// frontier: out_ptr (n + 1,), out_recv and out_slot, a pair whose
// receiver is its source left out (it can never fire). hit has three
// buffers: step t ORs its fired bits into buffer t % 3. A hit holds only
// columns not yet active, so hit_{t - 1} is newly_{t - 1}, the frontier
// of step t, at every vertex. Three lists of vertices (ids, and each one's
// first pair: the exclusive prefix of the out-degrees) rotate the same
// way: step t appends T_t, the receivers that some coin hit, to list
// t % 3, and T_{t - 1} is Q_t, the vertices with a frontier word not zero
// at step t (Q_0, the seeded vertices, is list 2, their seed words
// buffer 2). One grid barrier a step. Per step t, in one pass:
//   - propagate, in one of two modes, the same for every block (each reads
//     Q_t's pair count D_t after the barrier that ended step t - 1):
//     - push (D_t <= dense_limit): G lanes a pair g of Q_t, over its
//       words; g's vertex u is found by a search of the offsets
//       (find_entry), so a hub's row spreads over as many warps as its
//       pairs fill; where frontier(u, w) is not zero, cand = frontier(u,
//       w) & ~(active | hit_{t - 1} | hit_t)(v, w), and the fired bits go
//       into hit_t(v, w) with atomicOr;
//     - dense: the form's own pass over the whole graph (the gather form's
//       table walk, the scatter form's edge sweep), which reads the
//       frontier buffer whole;
//     either way the first hit of v at step t (a step stamp, swapped in
//     with atomicExch) appends v to T_t, a warp at a time: one 64-bit
//     atomicAdd reserves the warp's entries and their pairs together, so
//     the offsets rise along the list;
//   - fold, over Q_t: active |= hit_{t - 1} (the readers above OR
//     hit_{t - 1} in themselves, so they need not wait for it);
//   - clear, over T_{t - 2}: hit_{t - 2} = 0, the buffer step t + 1
//     writes (nobody reads it at step t); list (t + 1) % 3's counter is
//     zeroed for T_{t + 1} (every block read it at step t - 1);
//   - grid barrier; T_t's counter is Q_{t + 1}'s.
// The cascade stops before step t where Q_t is empty (t > 0): step t - 1
// hit nothing, so its newly was empty. After the last step the last
// hits are folded into active, and after a barrier the columns counted.
// OR is order-free and the coins are functions of (t, v, j, b mod runs)
// and the key alone, so active, counts and steps do not depend on the mode
// of any step, on the order of the lists, or on the racy reads of hit
// that only skip coins which cannot change it.
//
// State written inside a launch is read with ld.global.cg (__ldcg), so no
// stale L1 line is seen across a barrier.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ic {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Blocks per SM the kernels are compiled for (at most 64 registers a
// thread): the grid is two blocks an SM, so a grid barrier has 264
// arrivals on an H100, not the 1,056 of 256-thread blocks, 8 an SM.
constexpr int kMinBlocks = 2;
// Columns counted per pass of count_columns (shared memory, 16 KB).
constexpr int kCountCols = 4096;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Ctl {
  unsigned long long barrier;   // grid-barrier arrivals, monotonic
  unsigned long long list[3];   // list k: (vertices << 32) | their pairs
  unsigned int steps;           // steps run, written at the end
  unsigned int dense_steps;     // of which dense, written at the end
};
static_assert(sizeof(Ctl) == 40, "Ctl is CTL_WORDS int32 words");

// One cascade's arguments and state, shared by both forms.
struct Cascade {
  const uint32_t* seed;      // (n, W) seed words
  uint32_t* active;          // (n, W), uninitialized
  uint32_t* hits;            // (3, n, W): hit of step t in buffer t % 3
  int* lists;                // (7, n): stamps, ids of lists 0-2, offsets
  const int32_t* out_ptr;    // push lists: (n + 1,) row starts by source
  const int32_t* out_recv;   // (P,) receivers
  const int32_t* out_slot;   // (P,) the coins' slots
  const long long* key;      // (2,) Philox key words
  Ctl* ctl;
  int* counts;               // (B,)
  int n, W, B, runs;
  int G;                     // lanes per vertex or pair: min(32, 2^ceil(log2 W))
  int max_iters;
  unsigned long long thr;
  long long dense_limit;     // a step with more pairs than this is dense

  __device__ __forceinline__ uint32_t* hit(int k) const {
    return hits + static_cast<long long>(k) * n * W;
  }
  __device__ __forceinline__ int* stamp() const { return lists; }
  __device__ __forceinline__ int* ids(int k) const {
    return lists + static_cast<long long>(1 + k) * n;
  }
  __device__ __forceinline__ int* offs(int k) const {
    return lists + static_cast<long long>(4 + k) * n;
  }
};

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
        const int c = __popc(__ballot_sync(kFull, (x >> bit) & 1u));
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

// The warp's first work item of a warp-strided loop, and the stride.
__device__ __forceinline__ long long global_warp() {
  return (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
}
__device__ __forceinline__ long long grid_warps() {
  return static_cast<long long>(gridDim.x) * kWarps;
}

// True for exactly one caller that first hits v at step t.
__device__ __forceinline__ bool touch(int* stamp, int v, int t) {
  return __ldcg(stamp + v) != t && atomicExch(stamp + v, t) != t;
}

// Appends v to list k where `flag` (each lane its own v), with its pairs
// (out_ptr[v + 1] - out_ptr[v]) added to the list's pair count. Called by
// all 32 lanes of a warp together: one 64-bit atomicAdd reserves the
// warp's entries and their first pairs at once, so entries and offsets
// rise together along the list. A vertex is appended once per list (its
// stamp), so the pairs stay below P < 2^31 and never carry into the count.
__device__ __forceinline__ void append(const Cascade& c, int k, bool flag,
                                       int v) {
  if (!__ballot_sync(kFull, flag)) return;
  const int lane = threadIdx.x & 31;
  const unsigned long long mine =
      flag ? (1ull << 32) | static_cast<unsigned>(__ldg(c.out_ptr + v + 1) -
                                                  __ldg(c.out_ptr + v))
           : 0ull;
  unsigned long long x = mine;  // inclusive scan over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  unsigned long long base = 0;
  if (lane == 31) base = atomicAdd(&c.ctl->list[k], x);
  base = __shfl_sync(kFull, base, 31);
  if (flag) {
    const unsigned long long at = base + x - mine;
    const long long pos = static_cast<long long>(at >> 32);
    c.ids(k)[pos] = v;
    c.offs(k)[pos] = static_cast<int>(at & 0xFFFFFFFFull);
  }
}

// The lanes of this lane's group of G (for one vertex or one pair).
__device__ __forceinline__ unsigned group_mask(int G) {
  const int lane = threadIdx.x & 31;
  return (G == 32 ? kFull : ((1u << G) - 1u)) << (lane & ~(G - 1));
}

// active = seed, hit_{-1} (buffer 2) = seed, buffers 0 and 1 zero, every
// stamp -1; the vertices with a seed word not zero go to list 2 (Q_0). G
// lanes a vertex, over its words.
__device__ __forceinline__ void init(const Cascade& c) {
  const int lane = threadIdx.x & 31;
  const int G = c.G;
  const int per_warp = 32 / G;
  const int sub = lane & (G - 1);
  for (long long base = global_warp() * per_warp; base < c.n;
       base += grid_warps() * per_warp) {
    const long long v = base + lane / G;
    bool any = false;
    if (v < c.n) {
      for (int w = sub; w < c.W; w += G) {
        const long long vi = v * c.W + w;
        const uint32_t s = c.seed[vi];
        c.active[vi] = s;
        c.hit(0)[vi] = 0u;
        c.hit(1)[vi] = 0u;
        c.hit(2)[vi] = s;
        any |= s != 0u;
      }
      if (sub == 0) c.stamp()[v] = -1;
    }
    const bool seeded = (__ballot_sync(kFull, any) & group_mask(G)) != 0u;
    append(c, 2, sub == 0 && seeded, static_cast<int>(v));
  }
}

// The entry of list `offs` (nq entries, offsets rising from 0) that holds
// pair g: the last whose first pair is <= g (an entry of no pairs shares
// its offset with the next and is passed). Called by all 32 lanes of a
// warp together, each with its own g, where the warp's g lie in [g0, g0 +
// 32): the warp finds g0's entry q0 by a 32-way search (a load a lane,
// ceil(log32 nq) rounds), loads the 32 offsets from q0 and each lane
// searches them in registers; a lane whose g lies past them searches on
// alone.
__device__ __forceinline__ int find_entry(const int* offs, int nq,
                                          long long g0, long long g) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = nq;  // offs[lo] <= g0 < offs[hi] (offs[nq] = infinity)
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const bool le =
        __ldcg(offs + lo + static_cast<int>(span * lane / 32)) <= g0;
    const int k = __popc(__ballot_sync(kFull, le)) - 1;
    hi = k == 31 ? hi : lo + static_cast<int>(span * (k + 1) / 32);
    lo += static_cast<int>(span * k / 32);
  }
  const bool le = lo + lane < hi && __ldcg(offs + lo + lane) <= g0;
  const int q0 = lo + __popc(__ballot_sync(kFull, le)) - 1;
  const long long mine =
      q0 + lane < nq ? __ldcg(offs + q0 + lane) : 0x7FFFFFFFFFFFFFFFll;
  int j = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kFull, mine, j + step) <= g) j += step;
  }
  int q = q0 + j;
  if (j == 31) {  // past the loaded offsets
    int a = q, b = nq;
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (__ldcg(offs + mid) <= g) a = mid;
      else b = mid;
    }
    q = a;
  }
  return q;
}

// Push pass of step t over Q_t (list (t + 2) % 3: nq vertices, D pairs):
// G lanes a pair, over its words; touched receivers go to list t % 3.
__device__ __forceinline__ void push(const Cascade& c, int t, int nq,
                                     long long D, uint32_t k0, uint32_t k1) {
  const int lane = threadIdx.x & 31;
  const int G = c.G;
  const int per_warp = 32 / G;
  const int sub = lane & (G - 1);
  const int* ids = c.ids((t + 2) % 3);
  const int* offs = c.offs((t + 2) % 3);
  const uint32_t* frontier = c.hit((t + 2) % 3);
  uint32_t* hit = c.hit(t % 3);
  for (long long base = global_warp() * per_warp; base < D;
       base += grid_warps() * per_warp) {
    const long long g = base + lane / G;
    const int q = find_entry(offs, nq, base, g < D ? g : base);
    bool app = false;
    int v = 0;
    if (g < D) {
      const long long u = __ldcg(ids + q);
      const long long k = __ldg(c.out_ptr + u) + (g - __ldcg(offs + q));
      v = __ldg(c.out_recv + k);
      const uint32_t slot = static_cast<uint32_t>(__ldg(c.out_slot + k));
      bool any = false;
      for (int w = sub; w < c.W; w += G) {
        const uint32_t f = __ldcg(frontier + u * c.W + w);
        if (!f) continue;
        const long long vi = static_cast<long long>(v) * c.W + w;
        const uint32_t cand = f & ~(__ldcg(c.active + vi) |
                                    __ldcg(frontier + vi) | __ldcg(hit + vi));
        if (!cand) continue;
        const uint32_t fire =
            fired(cand, static_cast<uint32_t>(t), static_cast<uint32_t>(v),
                  slot, static_cast<uint32_t>(w),
                  static_cast<uint32_t>(c.runs), k0, k1, c.thr);
        if (fire) {
          atomicOr(hit + vi, fire);
          any = true;
        }
      }
      app = any && touch(c.stamp(), v, t);
    }
    append(c, t % 3, app, v);
  }
}

// G lanes a vertex of list k's first `count` entries, from the grid's far
// end (so that the walks run beside the push pass's first warps):
// active |= hit buffer k where `fold`, else hit buffer k = 0.
__device__ __forceinline__ void sweep_list(const Cascade& c, int k, int count,
                                           bool fold) {
  const int G = c.G;
  const int sub = threadIdx.x & (G - 1);
  const long long groups = static_cast<long long>(gridDim.x) * kThreads / G;
  const long long first =
      groups - 1 -
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int* list = c.ids(k);
  uint32_t* hit = c.hit(k);
  for (long long i = first; i < count; i += groups) {
    const long long v = __ldcg(list + i);
    for (int w = sub; w < c.W; w += G) {
      const long long vi = v * c.W + w;
      if (fold) {
        const uint32_t h = __ldcg(hit + vi);
        if (h) c.active[vi] = __ldcg(c.active + vi) | h;
      } else {
        hit[vi] = 0u;
      }
    }
  }
}

// One whole cascade. `dense(c, t, k0, k1)` is the form's dense pass of
// step t: it ORs the fired bits into hit buffer t % 3, reading the
// frontier from buffer (t + 2) % 3, and appends each vertex it touches
// first (touch, then append by all lanes of the warp) to list t % 3.
template <class Dense>
__device__ __forceinline__ void run(const Cascade& c, const Dense& dense) {
  __shared__ unsigned long long s_list;
  const uint32_t k0 = static_cast<uint32_t>(c.key[0]);
  const uint32_t k1 = static_cast<uint32_t>(c.key[1]);
  unsigned long long epoch = 0;
  int dense_steps = 0;

  init(c);
  grid_barrier(&c.ctl->barrier, epoch);
  if (threadIdx.x == 0) s_list = __ldcg(&c.ctl->list[2]);
  __syncthreads();
  int t = 0;
  int nold = 0;  // T_{t - 2}'s entries: Q_{t - 1}'s
  while (t < c.max_iters) {
    // Q_t's counter, read after the barrier that ended its appends
    const int nq = static_cast<int>(s_list >> 32);
    const long long D = static_cast<long long>(s_list & 0xFFFFFFFFull);
    if (t > 0 && nq == 0) break;  // step t - 1 activated no one
    if (D > c.dense_limit) {
      dense(c, t, k0, k1);
      ++dense_steps;
    } else {
      push(c, t, nq, D, k0, k1);
    }
    sweep_list(c, (t + 2) % 3, nq, true);
    sweep_list(c, (t + 1) % 3, nold, false);
    if (blockIdx.x == 0 && threadIdx.x == 0) c.ctl->list[(t + 1) % 3] = 0ull;
    grid_barrier(&c.ctl->barrier, epoch);
    // T_t's counter, final here: Q_{t + 1}'s
    if (threadIdx.x == 0) s_list = __ldcg(&c.ctl->list[t % 3]);
    __syncthreads();
    nold = nq;
    ++t;
  }
  // the last step's hits (none where the loop broke on an empty queue)
  sweep_list(c, (t + 2) % 3, static_cast<int>(s_list >> 32), true);
  grid_barrier(&c.ctl->barrier, epoch);
  count_columns(c.active, c.counts, c.n, c.W, c.B);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    c.ctl->steps = t;
    c.ctl->dense_steps = dense_steps;
  }
}

}  // namespace ic
